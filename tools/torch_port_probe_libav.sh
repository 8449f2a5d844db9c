#!/bin/sh
# Probe a machine for what the port's native decoder and encoder need:
# the FFmpeg shared libraries, their headers, libx264, g++, and whether
# native/video_decoder.cpp and native/video_encoder.cpp compile and link.
# Run from the root of a checkout:  sh tools/torch_port_probe_libav.sh
# Prints one "probe: <what>: <answer>" line per question; builds into a
# temporary directory that it removes.

out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT

echo "probe: libraries:"
ldconfig -p | grep -E 'libav(codec|format|util)|libswscale|libx264' || echo "probe: libraries: none found"
if echo '#include <libavcodec/avcodec.h>' | g++ -E -x c++ - >/dev/null 2>"$out/hdr.txt"; then
  echo "probe: headers: libavcodec/avcodec.h found"
else
  echo "probe: headers: missing ($(head -c 300 "$out/hdr.txt"))"
fi
echo "probe: pkg-config libavcodec: $(pkg-config --modversion libavcodec 2>&1 | head -n 1)"
echo "probe: g++: $(g++ --version 2>&1 | head -n 1)"
for name in video_decoder video_encoder; do
  if g++ -O3 -shared -fPIC -o "$out/lib$name.so" "native/$name.cpp" \
      -lavformat -lavcodec -lavutil -lswscale 2>"$out/$name.txt"; then
    echo "probe: build native/$name.cpp: ok"
  else
    echo "probe: build native/$name.cpp: failed"
    head -c 1500 "$out/$name.txt"
  fi
done
