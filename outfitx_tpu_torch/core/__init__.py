"""Configuration, dtype policy and device resolution."""
