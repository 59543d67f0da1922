"""Dense decoder model of the port: layers, attention, stack, model API."""
