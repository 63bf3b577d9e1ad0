"""The engine, the layer algebra and the tile planner of the port."""
