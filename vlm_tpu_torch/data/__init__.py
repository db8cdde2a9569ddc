"""The data layer of the zero-shot and probing paths: the port's own
copies of ``vlm_tpu.data``'s dataset readers, label parsers, dataset
registry with the task map and the multi-task dataset, augmentation and
tokenizers, and the background prefetch."""
