"""Event data: the model, the stores and the training read."""
