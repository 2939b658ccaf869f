"""Example problems built on the port."""
