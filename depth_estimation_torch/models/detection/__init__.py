"""The Mask-RCNN detection family: backbone, heads, losses, TTA."""
