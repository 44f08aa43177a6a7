"""path_mrays_s: rays the window's frames traced, as render() counts them
(shadow rays included), in millions, over the window's seconds."""


def read(rec):
    if not rec.get("frames") or not rec.get("rays"):
        return None
    return rec["rays"] / rec["window_s"] / 1e6
