"""The TransformerLM serving stack of the port."""
