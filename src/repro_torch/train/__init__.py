"""Training-side pieces of the port.  So far only the int8 block
quantizer and its predicted-CR size model (``grad_compress``), which the
serving layer's ``kv_gate`` method runs."""
