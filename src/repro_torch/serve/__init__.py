"""Serving layer of the port, in one process.

``serve.sweep_service.SweepService`` coalesces concurrent requests of
the methods of ``serve.method`` (featurize, find_eb, best_compressor,
kv_gate, advise, find_setting, quality; named by ``serve.registry``)
into batched launches on one device, deduplicates rows, unions their eb
grids and caches rows across requests.  Every served result is the bits
of the port's direct call.  The multi-process fabric comes with the
distributed layer."""
