"""Process supervision of the port (the service half of the reference's
``parallel/``)."""
