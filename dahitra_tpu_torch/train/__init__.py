"""Training: optimizer, schedules and the trainer."""
