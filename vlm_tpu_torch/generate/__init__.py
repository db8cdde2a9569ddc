"""Generation: sampling, prompt ids and the continuous batcher."""
