"""The parts of the server planes that split-streamed execution shares:
the stage cut (``scheduler``) and the host payload merge
(``pages_wire``). Transport, serialization and the server itself are not
ported yet."""
