"""Model layer of the port: GQA decoder backbone with exit heads."""
