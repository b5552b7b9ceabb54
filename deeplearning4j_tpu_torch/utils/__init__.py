"""Host-side utilities: the metrics registry, the model zip
(model_serializer), the fault-tolerance layer the fit loop, the
checkpoint listener and the serving tiers use (tracing, tenancy,
faultpoints, health, blackbox, sigchain, concurrency), and the serving
scaffolding (latency, resourcemeter, jsonhttp)."""
