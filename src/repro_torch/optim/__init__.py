"""AdamW and learning-rate schedules for the port's trainer."""
