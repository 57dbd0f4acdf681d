"""Serving: decode caches and the engine (``serve.engine``)."""
