"""Model building blocks of the port (dense LM family)."""
