"""Per fit, the card's time packing the test mask into bitplane words, on
the program's own ``singlet.pack`` span (CUDA events, logged once the
fit's output is on the host): the mean over the packs that began in the
window, in ms. A program without the span, or a route that packs
nothing, gives nothing."""

LAYER = "engine"
UNIT = "ms"


def read(run):
    ms = [e["device_ms"] for c in run.calls for e in c.events
          if e["event"] == "span" and e["name"] == "singlet.pack"
          and "device_ms" in e]
    return sum(ms) / len(ms) if ms else None
