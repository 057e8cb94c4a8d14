"""Device-to-host copies that overlap with other work."""


def start_host_copy(a):
    """Begin an async device->host copy and return the array.

    Starting every copy as soon as its result is dispatched and reading
    the values later overlaps the transfers with the device work that
    follows.  No-op for plain numpy inputs."""
    try:
        a.copy_to_host_async()
    except AttributeError:
        pass
    return a
