"""Event data: id maps and the events → rating triple read."""
