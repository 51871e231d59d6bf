"""Serving layer of the port.

``serve.sweep_service.SweepService`` coalesces concurrent requests of
the methods of ``serve.method`` (featurize, find_eb, best_compressor,
kv_gate, advise, find_setting, quality; named by ``serve.registry``)
into batched launches on one device, a mesh of shards or a process
group, deduplicates rows, unions their eb grids and caches rows across
requests.  Every served result is the bits of the port's direct call.

``serve.engine.Engine`` serves a language model (the dense, moe and
vlm families of ``models``): prefill, greedy decode, and a KV-cache gate that stores
int8-quantized the cache leaves whose predicted CR clears a ratio,
scored by ``train.grad_compress`` or by a service's ``kv_gate``
method."""
