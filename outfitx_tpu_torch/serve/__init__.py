"""Serving: the engine and its task functions, live updates, the request
coalescers and the HTTP app (``build_engine``, ``serve``)."""
