"""Serving layers of the port: HTTP shell, micro-batcher, AOT bucket warmup, engine server."""
