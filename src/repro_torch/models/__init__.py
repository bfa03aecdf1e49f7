"""Dense decoder of the serving path: layers, attention, blocks, the Model."""
