"""The UMD model: embeddings, ViT blocks, the auto-encoder."""
