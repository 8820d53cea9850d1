"""AdaPT-SGD training of the port: optimizer and loop."""
