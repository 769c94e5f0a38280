// The text of `bundle.out` (v0.3) and of the points PLY, formatted on the
// host from flat arrays (`io/bundle_text.py` binds it with ctypes).
//
// Every byte equals what the JAX package's writers write (its
// `io/bundlefile.py` and `io/plyfile.py`, one Python f-string a field):
// `%0.10e`, `%0.4f` and `%0.6e` are `std::to_chars` in scientific / fixed
// notation at the same precision, which rounds correctly as Python does;
// NaN is written `nan` whatever its sign (Python drops it, `to_chars`
// keeps it), infinities `inf` / `-inf`; a colour is `int(round(x))`, round
// half to even (`nearbyint` in the default rounding mode), a zero without
// its sign, an integer past 4.6e18 with every digit of the double (the
// caller refuses a colour that is not finite, as `int` does).  Text goes
// out in 1 MiB writes to a file descriptor the caller opened.  Host C++17,
// no CUDA; built with `-static-libstdc++`, so the library needs no GLIBCXX
// symbol version from the machine it loads on.

#include <unistd.h>

#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstring>
#include <memory>

namespace {

// The longest field is `%0.4f` of the largest double: 309 digits, the
// point, 4 decimals and a sign.  A line reserves room for its fields.
constexpr size_t kBuffer = 1 << 20;
constexpr size_t kLine = 2048;

class Writer {
 public:
  explicit Writer(int fd) : fd_(fd), buf_(new char[kBuffer]) {}

  // Room for `n` more bytes (n <= kLine).
  void reserve(size_t n) {
    if (pos_ + n > kBuffer) flush();
  }

  void text(const char* s) {
    const size_t n = std::strlen(s);
    reserve(n);
    std::memcpy(buf_.get() + pos_, s, n);
    pos_ += n;
  }

  void put(char c) { buf_[pos_++] = c; }

  void integer(long long v) {
    pos_ = std::to_chars(at(), end(), v).ptr - buf_.get();
  }

  // Python's `f"{x:0.<precision>e}"` / `f"{x:0.<precision>f}"`.
  void real(double x, std::chars_format fmt, int precision) {
    if (std::isnan(x)) {
      std::memcpy(at(), "nan", 3);
      pos_ += 3;
      return;
    }
    pos_ = std::to_chars(at(), end(), x, fmt, precision).ptr - buf_.get();
  }

  // Python's `int(round(x))` of a finite double (-0.0 converts to 0).
  void colour(double x) {
    const double r = std::nearbyint(x);
    if (std::fabs(r) < 4.6e18) {
      integer(static_cast<long long>(r));
    } else {
      real(r, std::chars_format::fixed, 0);
    }
  }

  // Writes what is buffered; false once a write failed.
  bool flush() {
    size_t off = 0;
    while (err_ == 0 && off < pos_) {
      const ssize_t n = ::write(fd_, buf_.get() + off, pos_ - off);
      if (n >= 0) {
        off += static_cast<size_t>(n);
      } else if (errno != EINTR) {
        err_ = errno;
      }
    }
    pos_ = 0;
    return err_ == 0;
  }

  // 0, or minus the errno of the first write that failed.
  int finish() { return flush() ? 0 : -err_; }

 private:
  char* at() { return buf_.get() + pos_; }
  char* end() { return buf_.get() + kBuffer; }

  int fd_;
  int err_ = 0;
  size_t pos_ = 0;
  std::unique_ptr<char[]> buf_;
};

void sci10_row(Writer& w, const double* v) {
  w.reserve(kLine);
  for (int k = 0; k < 3; ++k) {
    if (k) w.put(' ');
    w.real(v[k], std::chars_format::scientific, 10);
  }
  w.put('\n');
}

}  // namespace

extern "C" {

// `bundle.out` v0.3 into `fd`.  cams [C, 15]: f, k1, k2, R row-major, t
// (= -R·c); a camera whose f is 0 is unregistered and written as five
// lines of `0 0 0`.  Point p has pos [P, 3], colour [P, 3] and the views
// views[o_p : o_p + counts[p]] ([V, 2] image, key) and xy[...] ([V, 2]),
// o_p the sum of the counts before p; a point without views is left out,
// and the header counts the others.  Returns 0, or minus an errno.
int bundle_text_bundle(int fd, long long num_cams, const double* cams,
                       long long num_points, const double* pos,
                       const double* color, const long long* counts,
                       const long long* views, const double* xy) {
  Writer w(fd);
  long long visible = 0;
  for (long long p = 0; p < num_points; ++p) visible += counts[p] > 0;
  w.text("# Bundle file v0.3\n");
  w.reserve(kLine);
  w.integer(num_cams);
  w.put(' ');
  w.integer(visible);
  w.put('\n');
  for (long long c = 0; c < num_cams; ++c) {
    const double* cam = cams + 15 * c;
    if (cam[0] == 0.0) {
      w.text("0 0 0\n0 0 0\n0 0 0\n0 0 0\n0 0 0\n");
      continue;
    }
    for (int row = 0; row < 5; ++row) sci10_row(w, cam + 3 * row);
  }
  long long o = 0;
  for (long long p = 0; p < num_points; ++p) {
    const long long n = counts[p];
    if (n == 0) continue;
    sci10_row(w, pos + 3 * p);
    w.reserve(kLine);
    for (int k = 0; k < 3; ++k) {
      if (k) w.put(' ');
      w.colour(color[3 * p + k]);
    }
    w.put('\n');
    w.integer(n);
    for (long long v = o; v < o + n; ++v) {
      w.reserve(kLine);
      w.put(' ');
      w.integer(views[2 * v]);
      w.put(' ');
      w.integer(views[2 * v + 1]);
      w.put(' ');
      w.real(xy[2 * v], std::chars_format::fixed, 4);
      w.put(' ');
      w.real(xy[2 * v + 1], std::chars_format::fixed, 4);
    }
    w.reserve(1);
    w.put('\n');
    o += n;
  }
  return w.finish();
}

// The points PLY into `fd`: the header, then every vertex of pos [N, 3]
// whose colour [N, 3] is not (0, 0, 255) as `%0.6e` ×3 and three integers.
// Returns 0, or minus an errno.
int bundle_text_ply(int fd, long long n, const double* pos,
                    const double* color) {
  Writer w(fd);
  auto good = [&](long long i) {
    const double* c = color + 3 * i;
    return !(c[0] == 0.0 && c[1] == 0.0 && c[2] == 255.0);
  };
  long long kept = 0;
  for (long long i = 0; i < n; ++i) kept += good(i);
  w.text("ply\nformat ascii 1.0\nelement vertex ");
  w.reserve(kLine);
  w.integer(kept);
  w.text(
      "\nproperty float x\nproperty float y\nproperty float z\n"
      "property uchar diffuse_red\nproperty uchar diffuse_green\n"
      "property uchar diffuse_blue\nend_header\n");
  for (long long i = 0; i < n; ++i) {
    if (!good(i)) continue;
    w.reserve(kLine);
    for (int k = 0; k < 3; ++k) {
      w.real(pos[3 * i + k], std::chars_format::scientific, 6);
      w.put(' ');
    }
    for (int k = 0; k < 3; ++k) {
      if (k) w.put(' ');
      w.colour(color[3 * i + k]);
    }
    w.put('\n');
  }
  return w.finish();
}

}  // extern "C"
