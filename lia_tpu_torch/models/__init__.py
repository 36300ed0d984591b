"""Model definitions: the registry and the functional decoder."""
