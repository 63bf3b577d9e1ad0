"""Train-step builders and the training launcher of the port."""
