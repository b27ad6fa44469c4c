"""Local COCO-val reader and square-resized image batches."""
