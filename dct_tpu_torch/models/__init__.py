"""Model families (the transformer families in this slice) and the registry."""
