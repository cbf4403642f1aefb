"""``paddle.distributed.fleet`` subset of the port."""
