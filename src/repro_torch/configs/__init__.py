"""Full-size model configurations (data; copies of ``repro.configs``)."""
