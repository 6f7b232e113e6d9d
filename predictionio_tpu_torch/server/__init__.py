"""Serving layers of the port: HTTP shell, TLS, micro-batcher, AOT bucket
warmup, tenancy, event server with group-commit ingest, engine server."""
