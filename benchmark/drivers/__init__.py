"""One driver per kind of traffic, found by the traffic file's ``kind``:
``drivers/<kind>.py`` with a class ``Driver``."""
