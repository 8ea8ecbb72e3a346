"""Box ops, coders, rotated IoU and NMS."""
