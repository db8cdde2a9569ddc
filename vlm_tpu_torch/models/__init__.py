"""Models of the port: layers, vision tower, projector, decoder, the
assembled VLM, and the user-facing model classes."""
