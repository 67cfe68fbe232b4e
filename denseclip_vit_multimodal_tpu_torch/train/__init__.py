"""Training of the port: losses, schedules, optimizer state, the train step,
checkpoints and the loop (`train.loop.train`)."""
