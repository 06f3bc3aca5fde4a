"""Caption data."""
