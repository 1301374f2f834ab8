"""Device: the most memory the program held during the window
(``torch.cuda.max_memory_allocated``), in GB."""


def read(rec):
    v = rec.train.get("peak_bytes")
    return None if not v else v / 1e9
