"""The port's models: the paper's DCNNs as trainable models on the port's
engine (``dcnn``), and the LM stack's dense and VLM families for serving
(``layers``, ``mlp``, ``attention``, ``transformer``)."""
