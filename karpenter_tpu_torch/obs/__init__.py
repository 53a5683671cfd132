"""Observability plane of the port: the per-tick trace context
(``obs.context``), the cluster event ledger (``obs.events``) and the device
observatory (``obs.device``).  Submodules are imported where used."""
