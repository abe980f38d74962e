"""Event data: the storage layer, the event stores, the event server, id
maps and the events → rating triple read of an events file."""
