"""The benchmark's plain reference: the networks, losses and AdamW in
plain PyTorch, float32 with TF32 off, written from the configuration
files alone.  It imports nothing of the program under test."""
