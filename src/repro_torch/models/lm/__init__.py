"""LM-family configuration and building blocks (the LM half of the port)."""
