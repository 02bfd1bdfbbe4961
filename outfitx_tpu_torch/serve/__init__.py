"""Serving: the engine, its task functions and ``build_engine``."""
