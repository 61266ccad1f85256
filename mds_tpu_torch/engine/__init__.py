"""Training engine of the port: LR schedules, the optimizer, the train step."""
