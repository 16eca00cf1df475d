"""Entry points of the port: ``serve`` (batched decode serving)."""
