"""Training: optimizer, train step and the trainer loop."""
