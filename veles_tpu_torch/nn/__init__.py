"""Neural-network modules of the port: the transformer LM stack and its
KV-cached sampler."""
