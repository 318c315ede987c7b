"""Serving: the request handler, its micro-batcher and the HTTP worker."""
