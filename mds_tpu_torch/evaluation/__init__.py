"""mIoU evaluation of the port: the evaluators and the drivers the eval CLI runs."""
