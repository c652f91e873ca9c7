"""Tools of the port: checkpoint fabrication and sharding."""
