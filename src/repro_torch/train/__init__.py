"""Training of the port: the AdamW optimizer (``optimizer``), the
error-feedback gradient compression gated by the int8 q-ent size model
(``grad_compress``, whose quantizer the serving engine's KV gate shares),
the train step (``train_step``) and the loop with checkpoint/restart
(``loop``)."""
