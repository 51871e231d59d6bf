"""Serving layer of the port.  So far only the pieces the advisor needs
(``serve.method.slice_digest`` and ``AdviseMethod``'s static helpers);
the sweep service and its registry are still to come."""
