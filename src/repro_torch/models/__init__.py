"""The paper's DCNNs as trainable models on the port's engine."""
