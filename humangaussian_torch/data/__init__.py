"""Camera batches and posed-image data: Blender, COLMAP, multiview
captures, CO3D sequences and single reference images."""
