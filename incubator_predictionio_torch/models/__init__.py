"""Engine templates."""
