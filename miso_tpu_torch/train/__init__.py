"""Training: masked optimizers and the train step."""
