"""The REST ingestion API: the event server."""
