"""Dense GQA decoder of the port: layers, model, decode and prefill."""
