"""AdaPT core of the port: fixed-point words, init, and the serving half of
the precision controller."""
