"""Training-side pieces of the port.  So far only the int8 block
quantizer and its predicted-CR size model (``grad_compress``), which the
serving engine's KV gate and the service's ``kv_gate`` method run."""
