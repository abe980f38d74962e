"""Train/deploy plumbing: the workflow context, the train/deploy workflow
over the stores, model artifacts, checkpoints and the engine server."""
