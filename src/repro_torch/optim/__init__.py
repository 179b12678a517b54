"""AdamW and learning-rate schedules for the port's trainer, and the int8
error-feedback compression of the collectives' cross-pod hop."""
