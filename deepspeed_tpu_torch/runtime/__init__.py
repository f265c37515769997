"""The training runtime: config, LR schedules, loss scaling and the engine."""
