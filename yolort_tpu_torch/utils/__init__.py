"""Host-side helpers of the port: detection results and image drawing.
numpy only; OpenCV is imported where an image is read, drawn or written."""
