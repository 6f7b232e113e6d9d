"""Host-side helpers of the port: device resolution, id maps, metrics, tracing."""
