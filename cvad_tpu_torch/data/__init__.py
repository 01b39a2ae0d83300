"""Data of the port: frame-folder datasets (UCSD Ped2, Avenue), clip
windows, label policies, ground truth, host decode (the native core, cv2,
PIL), synthetic clips and trees, and the batching host feed."""
