"""Host utilities: observability counters, fault injection, request tracing."""
