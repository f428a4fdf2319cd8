"""The GPT model."""
