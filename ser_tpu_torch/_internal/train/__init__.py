"""Training metrics of the port."""
