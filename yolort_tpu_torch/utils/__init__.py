"""Host-side helpers of the port: detection results, image drawing,
magnitude pruning, box conversions, detection metrics, the YOLO-txt to
COCO converter and the dtype cast of a model.  numpy (and torch) only;
OpenCV is imported where an image is read, drawn or written."""
