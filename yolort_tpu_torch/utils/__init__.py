"""Host-side helpers of the port: detection results, image drawing and
magnitude pruning.  numpy only; OpenCV is imported where an image is
read, drawn or written."""
