"""Camera, reprojection, temporal tail, composite and the frame pipeline."""
