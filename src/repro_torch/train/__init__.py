"""Training: optimizer, checkpoints, gradient compression and the trainer
(single device; counterpart of the reference's ``repro.train``)."""
