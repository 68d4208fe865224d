"""Communication core of the port: the conduit and its link model."""
