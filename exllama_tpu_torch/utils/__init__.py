"""Tools of the port: checkpoint and adapter fabrication, sharding, and
the stop-string split of the streaming generators."""
