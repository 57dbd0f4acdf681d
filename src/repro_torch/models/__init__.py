"""Model assembly: layers, GQA attention, the serving drivers."""
