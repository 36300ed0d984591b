"""Parameter initialisation, conversion and metrics."""
