"""Language models of the port."""
