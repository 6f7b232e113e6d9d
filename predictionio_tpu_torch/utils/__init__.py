"""Host-side helpers of the port: device resolution, id maps, metrics and
their history, tracing, resilience, fault injection, atomic writes."""
