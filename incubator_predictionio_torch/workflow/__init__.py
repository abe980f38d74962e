"""Train/deploy plumbing: the workflow context and the engine server."""
