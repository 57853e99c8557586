/* Write arithmetic-coded (ITU T.81 SOF9, or SOF10 with progression) or
 * progressive JPEGs with the host's libjpeg, for the port's decoder tests
 * and file tree (scripts/make_torch_data_fixture.py, tests/
 * test_torch_imageio.py). PIL writes no arithmetic-coded JPEG.
 *
 *   gcc -O2 -o arith_jpeg scripts/arith_jpeg.c -ljpeg
 *   arith_jpeg W H C QUALITY PROGRESSIVE RESTART_ROWS HSAMP VSAMP < raw > out.jpg
 *   arith_jpeg transcode ARITH PROGRESSIVE < in.jpg > out.jpg
 *
 * Encode: raw is H x W x C bytes (C = 1 gray, 3 RGB); HSAMP x VSAMP the
 * first component's sampling factors (2 2 is 4:2:0, 2 1 is 4:2:2, 1 1
 * 4:4:4); RESTART_ROWS a restart marker every that many MCU rows (0:
 * none); the file is arithmetic-coded.
 * Transcode: the JPEG's own DCT coefficients written again, arithmetic-
 * or Huffman-coded (ARITH 1 or 0), sequential or progressive (libjpeg's
 * simple progression): the file decodes to exactly the same pixels.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static int transcode(int arith, int progressive) {
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jsrc, jdst;
  src.err = jpeg_std_error(&jsrc);
  jpeg_create_decompress(&src);
  dst.err = jpeg_std_error(&jdst);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, stdin);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coef = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = FALSE;
  if (progressive) jpeg_simple_progression(&dst);
  jpeg_stdio_dest(&dst, stdout);
  jpeg_write_coefficients(&dst, coef);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 4 && strcmp(argv[1], "transcode") == 0)
    return transcode(atoi(argv[2]), atoi(argv[3]));
  if (argc != 9) {
    fprintf(stderr, "usage: %s W H C QUALITY PROGRESSIVE RESTART_ROWS "
            "HSAMP VSAMP < raw > out.jpg\n       %s transcode ARITH "
            "PROGRESSIVE < in.jpg > out.jpg\n", argv[0], argv[0]);
    return 2;
  }
  const int w = atoi(argv[1]), h = atoi(argv[2]), c = atoi(argv[3]);
  const size_t n = (size_t)w * h * c;
  unsigned char* px = malloc(n);
  if (!px || fread(px, 1, n, stdin) != n) {
    fprintf(stderr, "expected %zu bytes on stdin\n", n);
    return 1;
  }
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, stdout);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, atoi(argv[4]), TRUE);
  cinfo.arith_code = TRUE;
  if (atoi(argv[5])) jpeg_simple_progression(&cinfo);
  cinfo.restart_in_rows = atoi(argv[6]);
  cinfo.comp_info[0].h_samp_factor = atoi(argv[7]);
  cinfo.comp_info[0].v_samp_factor = atoi(argv[8]);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px + (size_t)cinfo.next_scanline * w * c;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  free(px);
  return 0;
}
