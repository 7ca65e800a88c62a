"""Training substrate: optimizer, checkpointing, gradient compression and
the train loop (the port of ``repro/train``)."""
