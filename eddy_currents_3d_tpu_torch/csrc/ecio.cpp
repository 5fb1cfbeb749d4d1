// Native IO engine for eddy_currents_3d_tpu_torch: legacy big-endian VTK
// encoding for the simulation output path.  C++ counterpart of io/vtk.py's
// numpy writers (which mirror the reference's utilites.f90:3-293); produces
// byte-identical files.
//
// The port's own copy of the JAX package's native/ecio.cpp (ec3d_write_field
// at :101, ec3d_write_src at :192), with the same interface and bytes.
// Built with g++ -pthread into _build/ at first use (ops/_build.py), loaded
// by io/native.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

inline void put_f32_be(char* dst, float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    u = bswap32(u);
    std::memcpy(dst, &u, 4);
}

inline void put_f64_be(char* dst, double v) {
    uint64_t u;
    std::memcpy(&u, &v, 8);
    u = bswap64(u);
    std::memcpy(dst, &u, 8);
}

inline void put_i32_be(char* dst, int32_t v) {
    uint32_t u = bswap32(static_cast<uint32_t>(v));
    std::memcpy(dst, &u, 4);
}

// Fortran-style trim(adjustl()) of an i8 edit descriptor: the i8 field is
// right-justified in 8 columns; adjustl+trim leaves the bare digits.
std::string i8_trim(int64_t v) { return std::to_string(v); }

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nt = hw ? (hw > 8 ? 8 : hw) : 1;
    if (n < 1 << 16) nt = 1;
    std::vector<std::thread> ts;
    int64_t chunk = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& th : ts) th.join();
}

// interleave three component planes (each n doubles) into big-endian f32
// triples
void interleave3_f32(const double* x, const double* y, const double* z,
                     int64_t n, char* out) {
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            put_f32_be(out + 12 * i + 0, static_cast<float>(x[i]));
            put_f32_be(out + 12 * i + 4, static_cast<float>(y[i]));
            put_f32_be(out + 12 * i + 8, static_cast<float>(z[i]));
        }
    });
}

struct Writer {
    FILE* f;
    explicit Writer(const char* path) : f(std::fopen(path, "wb")) {}
    ~Writer() { if (f) std::fclose(f); }
    bool ok() const { return f != nullptr; }
    void text(const std::string& s) { std::fwrite(s.data(), 1, s.size(), f); }
    void raw(const std::vector<char>& b) { std::fwrite(b.data(), 1, b.size(), f); }
};

// clamped central difference along one axis of a (nz, ny, nx) field
// (utilites.f90:276-290): out = 0.5*(f[i+1]-f[i-1])/h with edge clamping
inline double cdiff(const double* f, int64_t nx, int64_t ny, int64_t nz,
                    int64_t ix, int64_t iy, int64_t iz, int axis, double h) {
    int64_t xp = ix, xm = ix, yp = iy, ym = iy, zp = iz, zm = iz;
    if (axis == 0) { xp = ix + 1 > nx - 1 ? nx - 1 : ix + 1; xm = ix - 1 < 0 ? 0 : ix - 1; }
    if (axis == 1) { yp = iy + 1 > ny - 1 ? ny - 1 : iy + 1; ym = iy - 1 < 0 ? 0 : iy - 1; }
    if (axis == 2) { zp = iz + 1 > nz - 1 ? nz - 1 : iz + 1; zm = iz - 1 < 0 ? 0 : iz - 1; }
    const double p = f[(zp * ny + yp) * nx + xp];
    const double m = f[(zm * ny + ym) * nx + xm];
    return 0.5 * (p - m) / h;
}

}  // namespace

extern "C" {

// Field file (STRUCTURED_GRID), byte-identical to io/vtk.py::write_field.
// A, carry: (3, nz, ny, nx) float64 C-order; cond: (nz,ny,nx) uint8 or
// nullptr.  eddy_scale = -1/mu0 (utilites.f90:239).
int ec3d_write_field(const char* path,
                     int64_t nx, int64_t ny, int64_t nz,
                     double dx, double dy, double dz,
                     const double* A, const double* carry,
                     const uint8_t* cond, double eddy_scale) {
    Writer w(path);
    if (!w.ok()) return 1;
    const int64_t n = nx * ny * nz;
    const std::string nl = "\n";

    w.text("# vtk DataFile Version 3.0\nout data result\nBINARY\n");
    // trim(adjustl()) of the '(i8," ",i8," ",i8)' edit: inner runs of the
    // 8-wide right-justified fields survive (utilites.f90:202-203)
    char dims[32];
    std::snprintf(dims, sizeof dims, "%8lld %8lld %8lld",
                  (long long)nx, (long long)ny, (long long)nz);
    const char* p = dims;
    while (*p == ' ') ++p;
    w.text(std::string("DATASET STRUCTURED_GRID\nDIMENSIONS ") + p + nl);
    w.text("POINTS " + i8_trim(n) + " float" + nl);

    std::vector<char> buf(static_cast<size_t>(n) * 12);
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t ix = i % nx, iy = (i / nx) % ny, iz = i / (nx * ny);
            put_f32_be(&buf[12 * i + 0], static_cast<float>(ix * dx));
            put_f32_be(&buf[12 * i + 4], static_cast<float>(iy * dy));
            put_f32_be(&buf[12 * i + 8], static_cast<float>(iz * dz));
        }
    });
    w.raw(buf); w.text(nl);
    w.text("POINT_DATA " + i8_trim(n) + nl);

    const double* Ax = A; const double* Ay = A + n; const double* Az = A + 2 * n;
    const double* Jx = carry; const double* Jy = carry + n; const double* Jz = carry + 2 * n;

    w.text("VECTORS Field_A float" + nl);
    interleave3_f32(Ax, Ay, Az, n, buf.data());
    w.raw(buf); w.text(nl);

    bool has_cond = false;
    if (cond) for (int64_t i = 0; i < n && !has_cond; ++i) has_cond = cond[i] != 0;

    if (has_cond) {
        w.text("VECTORS Vector_field_eddy float" + nl);
        parallel_for(n, [&](int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; ++i) {
                double m = cond[i] ? eddy_scale : 0.0;
                put_f32_be(&buf[12 * i + 0], static_cast<float>(cond[i] ? m * Jx[i] : 0.0));
                put_f32_be(&buf[12 * i + 4], static_cast<float>(cond[i] ? m * Jy[i] : 0.0));
                put_f32_be(&buf[12 * i + 8], static_cast<float>(cond[i] ? m * Jz[i] : 0.0));
            }
        });
        w.raw(buf); w.text(nl);
        w.text("VECTORS Vector_field_SOURCE float" + nl);
        parallel_for(n, [&](int64_t lo, int64_t hi) {
            for (int64_t i = lo; i < hi; ++i) {
                put_f32_be(&buf[12 * i + 0], static_cast<float>(cond[i] ? 0.0 : Jx[i]));
                put_f32_be(&buf[12 * i + 4], static_cast<float>(cond[i] ? 0.0 : Jy[i]));
                put_f32_be(&buf[12 * i + 8], static_cast<float>(cond[i] ? 0.0 : Jz[i]));
            }
        });
        w.raw(buf); w.text(nl);
    } else {
        w.text("VECTORS Vector_field_SOURCE float" + nl);
        interleave3_f32(Jx, Jy, Jz, n, buf.data());
        w.raw(buf); w.text(nl);
    }

    w.text("VECTORS Vector_field_B float" + nl);
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t ix = i % nx, iy = (i / nx) % ny, iz = i / (nx * ny);
            double bx = cdiff(Az, nx, ny, nz, ix, iy, iz, 1, dy)
                      - cdiff(Ay, nx, ny, nz, ix, iy, iz, 2, dz);
            double by = cdiff(Ax, nx, ny, nz, ix, iy, iz, 2, dz)
                      - cdiff(Az, nx, ny, nz, ix, iy, iz, 0, dx);
            double bz = cdiff(Ay, nx, ny, nz, ix, iy, iz, 0, dx)
                      - cdiff(Ax, nx, ny, nz, ix, iy, iz, 1, dy);
            put_f32_be(&buf[12 * i + 0], static_cast<float>(bx));
            put_f32_be(&buf[12 * i + 4], static_cast<float>(by));
            put_f32_be(&buf[12 * i + 8], static_cast<float>(bz));
        }
    });
    w.raw(buf); w.text(nl);
    return 0;
}

// Source file (UNSTRUCTURED_GRID of hexahedra), byte-identical to
// io/vtk.py::write_src.  cells: concatenated 0-based flat voxel ids;
// counts/values/dirs: per function (dir: 0=X,1=Y,2=Z).
int ec3d_write_src(const char* path,
                   int64_t nx, int64_t ny,
                   double dx, double dy, double dz,
                   const int64_t* cells, const int64_t* counts,
                   const double* values, const int32_t* dirs,
                   int64_t nfun) {
    Writer w(path);
    if (!w.ok()) return 1;
    const std::string nl = "\n";
    int64_t numcells = 0;
    for (int64_t k = 0; k < nfun; ++k) numcells += counts[k];

    w.text("# vtk DataFile Version 3.0\nout data result\nBINARY\n");
    w.text("DATASET UNSTRUCTURED_GRID" + nl);
    w.text("POINTS " + i8_trim(numcells * 8) + " double" + nl);

    static const double corner[8][3] = {
        {0,0,0},{1,0,0},{0,1,0},{1,1,0},{0,0,1},{1,0,1},{0,1,1},{1,1,1}};
    std::vector<char> buf(static_cast<size_t>(numcells) * 8 * 24);
    parallel_for(numcells, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t c = cells[i];
            double x0 = (c % nx) * dx;
            double y0 = ((c / nx) % ny) * dy;
            double z0 = (c / (nx * ny)) * dz;
            for (int p = 0; p < 8; ++p) {
                char* dst = &buf[(i * 8 + p) * 24];
                put_f64_be(dst + 0,  x0 + corner[p][0] * dx);
                put_f64_be(dst + 8,  y0 + corner[p][1] * dy);
                put_f64_be(dst + 16, z0 + corner[p][2] * dz);
            }
        }
    });
    w.raw(buf); w.text(nl);

    w.text("CELLS " + i8_trim(numcells) + " " + i8_trim(9 * numcells) + nl);
    buf.resize(static_cast<size_t>(numcells) * 9 * 4);
    for (int64_t i = 0; i < numcells; ++i) {
        char* dst = &buf[i * 36];
        put_i32_be(dst, 8);
        for (int p = 0; p < 8; ++p) put_i32_be(dst + 4 + 4 * p, static_cast<int32_t>(8 * i + p));
    }
    w.raw(buf); w.text(nl);

    w.text("CELL_TYPES " + i8_trim(numcells) + nl);
    buf.resize(static_cast<size_t>(numcells) * 4);
    for (int64_t i = 0; i < numcells; ++i) put_i32_be(&buf[4 * i], 11);
    w.raw(buf); w.text(nl);

    w.text("CELL_DATA " + i8_trim(numcells) + nl);
    w.text("VECTORS Vector_field_SRC double" + nl);
    buf.resize(static_cast<size_t>(numcells) * 24);
    int64_t at = 0;
    for (int64_t k = 0; k < nfun; ++k) {
        for (int64_t j = 0; j < counts[k]; ++j, ++at) {
            char* dst = &buf[at * 24];
            double v[3] = {0.0, 0.0, 0.0};
            v[dirs[k]] = values[k];
            put_f64_be(dst + 0, v[0]);
            put_f64_be(dst + 8, v[1]);
            put_f64_be(dst + 16, v[2]);
        }
    }
    w.raw(buf); w.text(nl);
    return 0;
}

}  // extern "C"
