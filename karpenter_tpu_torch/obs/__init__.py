"""Observability plane of the port: the per-tick trace context
(``obs.context``), the cluster event ledger (``obs.events``), the device
observatory (``obs.device``), and the diagnosis layer: the SLO engine
(``obs.slo``), the anomaly detector (``obs.detect``), the flight recorder
(``obs.flight``), the telemetry endpoint (``obs.http``), the trace renderer
(``obs.render``) and the doctor (``obs.doctor``).  Submodules are imported
where used."""
