"""Flow matching of the port: the CFM samplers and the trainable quantizers."""
