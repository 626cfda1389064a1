"""MotionTransformer, MusicEncoder and the frozen ST-GCN motion encoder."""
