"""Training substrate: optimizer, data, checkpoint, loop (the port of
``repro/training``)."""
