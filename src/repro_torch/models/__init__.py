"""Dense decoder: config, layers, attention, stack, loss."""
