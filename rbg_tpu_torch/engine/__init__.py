"""Serving engine of the port: paged KV pool, continuous batching, service
loop and wire server."""
