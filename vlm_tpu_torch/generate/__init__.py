"""Generation: sampling, prompt ids, the wave engine, beam search and the
continuous batcher."""
