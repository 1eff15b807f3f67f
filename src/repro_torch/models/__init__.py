"""Model families of the port (the paper's CNN zoo so far)."""
