"""Generation engine."""
