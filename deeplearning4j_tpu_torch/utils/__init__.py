"""Host-side utilities: the metrics registry, the model zip
(model_serializer), and the fault-tolerance layer the fit loop and the
checkpoint listener use (tracing, tenancy, faultpoints, health,
blackbox, sigchain, concurrency)."""
